"""``python3 -m clawker_tpu_torch.agentd``: the port's copy of
``clawker_tpu/agentd/__main__.py``."""

from .daemon import main

raise SystemExit(main())
