"""Comment-preserving YAML edits: surgical line patches, verified.

The port's copy of ``clawker_tpu/storage/yamledit.py``, whole.

The reference stores YAML as yaml.Node trees, so provenance-routed
writes keep comments and ordering byte-for-byte.  PyYAML has no node
round-trip, so this module patches the original TEXT instead: locate the
mapping line for a dotted path by an indentation scan, replace/insert/
delete just those lines, and VERIFY the result re-parses to exactly the
intended tree.  Block-sequence edits are item-surgical too: replacing,
inserting or deleting individual items (the hand-commented egress-rule
lists are the hot case) touches only that item's lines, so comments on
the key line and on OTHER items survive.  Anything not surgically
expressible (flow mappings/lists, anchors, multi-line scalars, list
reshuffles...) returns None and the caller falls back to a full
re-dump -- correctness never depends on this module, only comment
survival does.
"""

from __future__ import annotations

import re

import yaml

_KEY_LINE = re.compile(r"^(\s*)([A-Za-z0-9_.\-\"']+)\s*:(.*)$")


def _render_scalar(value) -> str:
    """One-line YAML rendering of a scalar/short value."""
    text = yaml.safe_dump(value, default_flow_style=True, width=10**6).strip()
    if text.endswith("\n..."):
        text = text[:-4].strip()
    return text


def _render_block(key: str, value, indent: int) -> list[str]:
    """Render ``key: value`` as indented block lines."""
    pad = " " * indent
    if isinstance(value, (dict, list)) and value:
        body = yaml.safe_dump({key: value}, default_flow_style=False,
                              sort_keys=False)
        return [pad + line if line.strip() else line
                for line in body.rstrip("\n").split("\n")]
    return [f"{pad}{key}: {_render_scalar(value)}"]


class _Doc:
    """Indentation-indexed view of a YAML mapping document."""

    def __init__(self, text: str):
        self.lines = text.split("\n")
        # path -> (line_no, indent, inline_rest)
        self.index: dict[tuple[str, ...], tuple[int, int, str]] = {}
        self.ok = self._scan()

    def _scan(self) -> bool:
        stack: list[tuple[int, str]] = []   # (indent, key)
        item_guard: int | None = None       # indent of the innermost "- "
        for i, line in enumerate(self.lines):
            stripped = line.strip()
            if not stripped or stripped.startswith("#"):
                continue
            indent = len(line) - len(line.lstrip())
            if stripped == "-" or stripped.startswith("- "):
                # sequence items (and the keys inside them) are indexed
                # by _seq_items per edit, not here; guard their interiors
                if item_guard is None or indent < item_guard:
                    item_guard = indent
                continue
            if item_guard is not None:
                if indent > item_guard:
                    continue        # key inside an item's block
                item_guard = None   # left the sequence
            m = _KEY_LINE.match(line)
            if m is None:
                # multi-line scalar bodies etc.: tolerated as long as no
                # edit lands inside them (verification catches otherwise)
                continue
            key = m.group(2).strip("\"'")
            while stack and stack[-1][0] >= indent:
                stack.pop()
            stack.append((indent, key))
            path = tuple(k for _, k in stack)
            if path in self.index:
                return False  # duplicate key path: ambiguous target
            self.index[path] = (i, indent, m.group(3))
        return True

    def subtree_end(self, line_no: int, indent: int) -> int:
        """Last line (exclusive) of the block owned by the key line."""
        j = line_no + 1
        last_content = line_no + 1
        while j < len(self.lines):
            s = self.lines[j].strip()
            if s and not s.startswith("#"):
                cur = len(self.lines[j]) - len(self.lines[j].lstrip())
                if cur <= indent:
                    break
                last_content = j + 1
            j += 1
        return last_content


def _diff(before, after, prefix=()) -> list[tuple[str, tuple, object]]:
    """(op, path, payload) edits turning ``before`` into ``after``.

    Ops: set/del on mapping keys; setitem/delitem/insitem on sequence
    positions (payload = (index, value)), so single-item list changes --
    the egress-rule hot case -- patch one item's lines instead of
    re-dumping the whole block.  Unexpressible list reshapes degrade to
    a whole-value set."""
    out: list[tuple[str, tuple, object]] = []
    if isinstance(before, list) and isinstance(after, list):
        return _diff_list(before, after, prefix)
    if not isinstance(before, dict) or not isinstance(after, dict):
        if before != after:
            out.append(("set", prefix, after))
        return out
    for key in before:
        if key not in after:
            out.append(("del", prefix + (key,), None))
    for key, val in after.items():
        if key not in before:
            out.append(("set", prefix + (key,), val))
        elif before[key] != val:
            out.extend(_diff(before[key], val, prefix + (key,)))
    return out


def _diff_list(b: list, a: list, prefix: tuple) -> list[tuple[str, tuple, object]]:
    if b == a:
        return []
    if not a or not b:
        return [("set", prefix, a)]
    if len(a) == len(b):
        return [("setitem", prefix, (i, a[i]))
                for i in range(len(b)) if b[i] != a[i]]
    if len(a) < len(b):
        # removals with order preserved: two-pointer match; emitted
        # DESCENDING so earlier indices stay valid while applying
        dels, ai = [], 0
        for bi, item in enumerate(b):
            if ai < len(a) and item == a[ai]:
                ai += 1
            else:
                dels.append(bi)
        if ai == len(a):
            return [("delitem", prefix, (i, None)) for i in reversed(dels)]
        return [("set", prefix, a)]
    # insertions with order preserved: indices are final-array positions,
    # emitted ASCENDING so each insert lands before the right neighbor
    ins, bi = [], 0
    for ai, item in enumerate(a):
        if bi < len(b) and item == b[bi]:
            bi += 1
        else:
            ins.append((ai, item))
    if bi == len(b):
        return [("insitem", prefix, (i, v)) for i, v in ins]
    return [("set", prefix, a)]


def apply_edits(text: str, after: dict) -> str | None:
    """Patch ``text`` so it parses to ``after``, keeping comments and
    ordering.  None when the change is not surgically expressible (the
    caller re-dumps)."""
    try:
        before = yaml.safe_load(text) or {}
    except yaml.YAMLError:
        return None
    if not isinstance(before, dict):
        return None
    edits = _diff(before, after)
    if not edits:
        return text
    lines_text = text
    for op, path, value in sorted(edits, key=lambda e: len(e[1]), reverse=True):
        doc = _Doc(lines_text)
        if not doc.ok:
            return None
        patched = _apply_one(doc, op, path, value)
        if patched is None:
            return None
        lines_text = patched
    try:
        if yaml.safe_load(lines_text) != after:
            return None
    except yaml.YAMLError:
        return None
    return lines_text


def _seq_items(
    doc: _Doc, spath: tuple,
) -> tuple[list[tuple[int, int]], list[int], int] | None:
    """(comment-widened item spans, raw ``-`` line numbers, item indent)
    for the block sequence at ``spath``.  None when the list is not a
    plain block sequence (inline/flow, nested weirdness) -- callers
    fall back."""
    hit = doc.index.get(spath)
    if hit is None:
        return None
    line_no, indent, rest = hit
    if rest.strip() and not rest.strip().startswith("#"):
        return None  # flow list on the key line
    # items may legally sit at the SAME indent as their key (PyYAML's
    # default dump style), so the extent cannot come from subtree_end;
    # walk until a content line that is neither an item at item_indent
    # nor an item-interior line
    starts: list[int] = []
    item_indent = -1
    last_content = line_no
    for j in range(line_no + 1, len(doc.lines)):
        s = doc.lines[j]
        st = s.strip()
        if not st or st.startswith("#"):
            continue
        cur = len(s) - len(s.lstrip())
        is_item = st == "-" or st.startswith("- ")
        if item_indent < 0:
            if not (is_item and cur >= indent):
                return None  # first content under the key is not an item
            item_indent = cur
            starts.append(j)
            last_content = j
            continue
        if is_item and cur == item_indent:
            starts.append(j)
            last_content = j
        elif cur > item_indent:
            last_content = j   # item interior (incl. nested sequences)
        else:
            break              # left the sequence
    if not starts:
        return None
    # the sequence ends at its last CONTENT line: a standalone comment
    # block between the last item and the next key belongs to whatever
    # follows, so deleting/appending items never touches it
    end = last_content + 1
    # a comment block immediately above an item describes THAT item:
    # widen each span backwards over contiguous comment/blank lines so
    # deleting an item removes its own commentary and deleting its
    # predecessor keeps it
    widened: list[int] = []
    for k, s in enumerate(starts):
        floor = starts[k - 1] if k else line_no
        j = s
        while j - 1 > floor:
            st = doc.lines[j - 1].strip()
            if st and not st.startswith("#"):
                break  # previous item's (or the key's) content line
            j -= 1
        widened.append(j)
    spans = [(w, widened[k + 1] if k + 1 < len(widened) else end)
             for k, w in enumerate(widened)]
    return spans, starts, item_indent


def _render_item(value, indent: int) -> list[str]:
    body = yaml.safe_dump([value], default_flow_style=False, sort_keys=False)
    pad = " " * indent
    return [pad + line if line.strip() else line
            for line in body.rstrip("\n").split("\n")]


def _apply_item(doc: _Doc, op: str, spath: tuple, payload) -> str | None:
    got = _seq_items(doc, spath)
    if got is None:
        return None
    spans, starts, item_indent = got
    idx, value = payload
    if op == "delitem":
        # an item dies with its own leading comment block
        if not 0 <= idx < len(spans):
            return None
        s, e = spans[idx]
        return "\n".join(doc.lines[:s] + doc.lines[e:])
    if op == "setitem":
        # only the item's content is replaced; its leading comment block
        # keeps describing the (updated) item
        if not 0 <= idx < len(spans):
            return None
        s, e = starts[idx], spans[idx][1]
        return "\n".join(doc.lines[:s] + _render_item(value, item_indent)
                         + doc.lines[e:])
    # insitem: before the comment block of the item currently at idx (so
    # that comment stays with the item it describes); past-the-end appends
    if idx > len(spans):
        return None
    at = spans[idx][0] if idx < len(spans) else spans[-1][1]
    return "\n".join(doc.lines[:at] + _render_item(value, item_indent)
                     + doc.lines[at:])


def _block_end(doc: _Doc, spath: tuple, line_no: int, indent: int) -> int:
    """End (exclusive) of the value block owned by a key line, covering
    sequences whose items sit at the key's own indent (subtree_end's
    indentation rule cannot see those)."""
    end = doc.subtree_end(line_no, indent)
    got = _seq_items(doc, spath)
    if got is not None:
        end = max(end, got[0][-1][1])   # last widened span's end
    return end


def _apply_one(doc: _Doc, op: str, path: tuple, value) -> str | None:
    spath = tuple(str(p) for p in path)
    if op in ("setitem", "delitem", "insitem"):
        return _apply_item(doc, op, spath, value)
    hit = doc.index.get(spath)
    if op == "del":
        if hit is None:
            return None
        line_no, indent, _ = hit
        end = _block_end(doc, spath, line_no, indent)
        out = doc.lines[:line_no] + doc.lines[end:]
        # deleting the last child leaves `parent:` parsing as null, not
        # the empty mapping the tree holds: pin it to `parent: {}`
        parent = spath[:-1]
        if parent and not any(
                p[:len(parent)] == parent and p != spath and len(p) > len(parent)
                for p in doc.index):
            pline, pindent, prest = doc.index[parent]
            if not prest.strip() or prest.strip().startswith("#"):
                comment = f"  {prest.strip()}" if prest.strip() else ""
                out[pline] = " " * pindent + f"{parent[-1]}: {{}}" + comment
        return "\n".join(out)
    # set
    if hit is not None:
        line_no, indent, rest = hit
        if isinstance(value, (dict, list)) and value:
            # replacing a whole block: delete + re-insert rendered block
            end = _block_end(doc, spath, line_no, indent)
            block = _render_block(spath[-1], value, indent)
            return "\n".join(doc.lines[:line_no] + block + doc.lines[end:])
        # scalar in place: keep any trailing comment on the line
        comment = ""
        m = re.search(r"\s#(?![^\"']*[\"'][^#]*$).*$", rest)
        if m and not rest.strip().startswith("#"):
            comment = m.group(0)
        elif rest.strip().startswith("#"):
            comment = "  " + rest.strip()
        new_line = (" " * indent + f"{spath[-1]}: {_render_scalar(value)}"
                    + comment)
        end = _block_end(doc, spath, line_no, indent)
        if end > line_no + 1:
            # key owned a nested block: replace the whole block
            return "\n".join(doc.lines[:line_no] + [new_line] + doc.lines[end:])
        return "\n".join(doc.lines[:line_no] + [new_line] + doc.lines[line_no + 1:])
    # new key: insert under the deepest existing ancestor.  The suffix
    # below the ancestor nests into one rendered block.
    for depth in range(len(spath) - 1, -1, -1):
        anc = spath[:depth]
        suffix = spath[depth:]
        nested = _nest(suffix[1:], value)
        if not anc:
            body = _render_block(suffix[0], nested, 0)
            out = doc.lines[:]
            while out and not out[-1].strip():
                out.pop()
            return "\n".join(out + body)
        hit = doc.index.get(anc)
        if hit is None:
            continue
        line_no, indent, rest = hit
        if rest.strip() and not rest.strip().startswith("#"):
            return None  # ancestor holds an inline value: not expressible
        child_indent = _child_indent(doc, line_no, indent)
        end = doc.subtree_end(line_no, indent)
        body = _render_block(suffix[0], nested, child_indent)
        return "\n".join(doc.lines[:end] + body + doc.lines[end:])
    return None


def _nest(keys: tuple, value):
    for key in reversed(keys):
        value = {key: value}
    return value


def _child_indent(doc: _Doc, line_no: int, indent: int) -> int:
    """Indent of the key's existing children, or indent+2."""
    for j in range(line_no + 1, len(doc.lines)):
        s = doc.lines[j].strip()
        if not s or s.startswith("#"):
            continue
        cur = len(doc.lines[j]) - len(doc.lines[j].lstrip())
        if cur <= indent:
            break
        return cur
    return indent + 2
