"""Built-in scene registry (the analog of internal/scenes).

Counterpart of `izpi_tpu/scene/library/__init__.py` over the scenes ported
so far: the hand-written Cornell constructors, `cornell_box_obj` and every
extracted `.pbtxt` scene (`extracted`). The JAX registry's Shirley scenes
and the rest of `misc` are not ported yet (ROADMAP A10, A11).
"""

from izpi_tpu_torch.scene.library import (cornell, cornell_spectral,
                                          extracted, misc)

# name -> fn(aspect) -> Scene
REGISTRY = {
    "cornell_box": cornell.cornell_box,
    "cornell_box_spectral_simple": cornell_spectral.cornell_box_spectral,
    "cornell_box_pyramid_spectral": (
        lambda aspect=1.0: cornell_spectral.cornell_box_spectral(
            aspect, with_prism=True)),
    "cornell_box_obj": misc.cornell_box_obj,
}
REGISTRY.update(extracted.CONSTRUCTORS)


def get_scene(name: str, aspect: float = 1.0):
    if name not in REGISTRY:
        raise KeyError(
            f"unknown scene {name!r}; available: {sorted(REGISTRY)}")
    return REGISTRY[name](aspect)
