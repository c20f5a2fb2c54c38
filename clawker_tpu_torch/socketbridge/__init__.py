"""Socket bridge: host SSH/GPG agent sockets forwarded into containers.

Parity reference: internal/socketbridge -- length-prefixed mux over a
``docker exec`` stdio channel; the container side materializes unix
sockets the agent's ssh/gpg point at, the host side relays each
connection to the real ``SSH_AUTH_SOCK`` / gpg-agent extra socket.
Keys never enter the container; only agent-protocol traffic does.

No eager imports here: this ``__init__`` also ships inside the agentd
zipapp, where only the stdlib-only ``protocol``/``container`` halves
exist -- ``host`` (which pulls framework modules) is host-side only.

The port's copy of ``clawker_tpu/socketbridge``.  The agentd zipapp that
carries ``protocol`` and ``container`` into a real container comes with
the agentd zipapp builder, with the image builds (ROADMAP §1 item 13);
on the fake engine
the bridge runs against the fake's exec handler, and over the ``local``
driver its exec rides the HTTP client's ``101`` hijack.
"""
