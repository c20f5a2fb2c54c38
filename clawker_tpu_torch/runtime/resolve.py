"""Image reference resolution, including the ``@`` placeholder shortcut.

The port's copy of ``clawker_tpu/runtime/resolve.py``, whole.

Parity reference: internal/cmd/container/shared ResolvePlaceholderImage
(run.go:207) + internal/docker/image_resolve.go.  ``@`` resolves to the
project's default harness image ``clawker-<project>:default``; ``@base`` /
``@<tag>`` select another project image tag; anything else is a literal
reference (pulled on demand when absent).
"""

from __future__ import annotations

from .. import consts
from ..engine.api import Engine
from ..errors import NotFoundError
from .names import image_ref


def resolve_image(engine: Engine, project: str, image_arg: str, *, pull_missing: bool = True) -> str:
    if image_arg.startswith("@"):
        tag = image_arg[1:] or consts.IMAGE_TAG_DEFAULT
        ref = image_ref(project, tag)
        if not engine.image_exists(ref):
            raise NotFoundError(
                f"project image {ref} not built yet -- run `clawker build` first"
            )
        return ref
    if not engine.image_exists(image_arg) and pull_missing:
        for _ in engine.pull_image(image_arg):
            pass
        if not engine.image_exists(image_arg):
            raise NotFoundError(f"image {image_arg} not found and pull failed")
    return image_arg
