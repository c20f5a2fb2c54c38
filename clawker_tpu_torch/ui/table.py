"""Column-aligned tables (parity: internal/iostreams/table.go).

The port's copy of ``clawker_tpu/ui/table.py``, whole.

ANSI-aware alignment: styled cells pad by their visible width.
"""

from __future__ import annotations

from .colors import visible_len


def render_table(headers: list[str], rows: list[list[str]],
                 *, max_width: int = 0, gap: int = 2) -> str:
    cols = len(headers)
    widths = [visible_len(h) for h in headers]
    for row in rows:
        for i in range(min(cols, len(row))):
            widths[i] = max(widths[i], visible_len(row[i]))

    if max_width:
        # shrink the widest column until the table fits (truncate cells)
        sep = gap * (cols - 1)
        while sum(widths) + sep > max_width and max(widths) > 8:
            widths[widths.index(max(widths))] -= 1

    def fmt(row: list[str]) -> str:
        out = []
        for i in range(cols):
            cell = row[i] if i < len(row) else ""
            w = widths[i]
            if visible_len(cell) > w:
                # truncate on visible chars, keep a marker
                plain, count = [], 0
                for ch in cell:
                    if count >= w - 1:
                        break
                    plain.append(ch)
                    if ch != "\x1b":
                        count += 1
                cell = "".join(plain) + "…"
            pad = " " * (w - visible_len(cell))
            out.append(cell + (pad if i < cols - 1 else ""))
        return (" " * gap).join(out).rstrip()

    lines = [fmt(headers)] + [fmt(r) for r in rows]
    return "\n".join(lines) + "\n"
