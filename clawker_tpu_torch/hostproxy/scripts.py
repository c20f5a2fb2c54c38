"""Container-side host-proxy scripts, baked into every harness image.

Parity reference: internal/hostproxy/internals (host-open.sh,
git-credential-clawker.sh, callback-forwarder) embedded by the bundler.
All three speak plain HTTP to ``$CLAWKER_HOSTPROXY`` (the host-gateway
address the runtime injects at create time) and degrade to no-ops when
the variable is unset, so images work unchanged with the proxy disabled.

The port's copy of ``clawker_tpu/hostproxy/scripts.py``, whole.  The
image build that bakes them in (``bundler/``) is not ported yet.
"""

from __future__ import annotations

HOST_OPEN_SH = """#!/bin/sh
# host-open URL -- open a URL in the HOST browser via the clawker proxy.
set -eu
[ -n "${1:-}" ] || { echo "usage: host-open URL" >&2; exit 2; }
[ -n "${CLAWKER_HOSTPROXY:-}" ] || { echo "host-open: no host proxy configured" >&2; exit 1; }
# JSON-encode through python3: quotes/backslashes in URLs must not break the body
payload=$(python3 -c 'import json,sys; print(json.dumps({"url": sys.argv[1]}))' "$1")
curl -fsS -X POST -H 'Content-Type: application/json' \\
    -d "$payload" "$CLAWKER_HOSTPROXY/open/url" >/dev/null
"""

GIT_CREDENTIAL_SH = """#!/bin/sh
# git-credential-clawker -- git credential helper backed by the HOST
# credential store via the clawker proxy (fills only; store/erase no-op).
set -eu
action="${1:-}"
[ "$action" = "get" ] || exit 0
[ -n "${CLAWKER_HOSTPROXY:-}" ] || exit 0
body=$(cat)
curl -fsS -X POST --data-binary "$body" \\
    "$CLAWKER_HOSTPROXY/git/credential" 2>/dev/null || true
"""

OAUTH_FORWARD_SH = """#!/bin/sh
# oauth-forward PORT -- capture one OAuth callback hitting the HOST's
# 127.0.0.1:PORT and print the captured query JSON (polls the proxy).
set -eu
[ -n "${1:-}" ] || { echo "usage: oauth-forward PORT [timeout_s]" >&2; exit 2; }
[ -n "${CLAWKER_HOSTPROXY:-}" ] || { echo "oauth-forward: no host proxy" >&2; exit 1; }
timeout="${2:-300}"
resp=$(curl -fsS -X POST -H 'Content-Type: application/json' \\
    -d "{\\"port\\": $1}" "$CLAWKER_HOSTPROXY/oauth/listen")
session=$(printf '%s' "$resp" | sed -n 's/.*"session": *"\\([^"]*\\)".*/\\1/p')
[ -n "$session" ] || { echo "oauth-forward: listen failed: $resp" >&2; exit 1; }
elapsed=0
while [ "$elapsed" -lt "$timeout" ]; do
    code=$(curl -s -o /tmp/.oauth-cb -w '%{http_code}' \\
        "$CLAWKER_HOSTPROXY/oauth/poll?session=$session")
    if [ "$code" = "200" ]; then cat /tmp/.oauth-cb; rm -f /tmp/.oauth-cb; exit 0; fi
    sleep 1; elapsed=$((elapsed + 1))
done
echo "oauth-forward: timed out after ${timeout}s" >&2
exit 1
"""

# arcname-in-context -> (target path, content)
CONTEXT_SCRIPTS = {
    "hostproxy/host-open": ("/usr/local/bin/host-open", HOST_OPEN_SH),
    "hostproxy/git-credential-clawker": (
        "/usr/local/bin/git-credential-clawker", GIT_CREDENTIAL_SH),
    "hostproxy/oauth-forward": ("/usr/local/bin/oauth-forward", OAUTH_FORWARD_SH),
}
