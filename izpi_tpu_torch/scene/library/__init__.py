"""Built-in scene registry (the analog of internal/scenes).

Counterpart of `izpi_tpu/scene/library/__init__.py`, name for name: the
hand-written constructors (cornell, Shirley's scenes, misc) and every
extracted `.pbtxt` scene (`extracted`).
"""

from izpi_tpu_torch.scene.library import (cornell, cornell_spectral,
                                          extracted, misc, shirley)

# name -> fn(aspect) -> Scene
REGISTRY = {
    "cornell_box": cornell.cornell_box,
    "cornell_box_spectral_simple": cornell_spectral.cornell_box_spectral,
    "cornell_box_pyramid_spectral": (
        lambda aspect=1.0: cornell_spectral.cornell_box_spectral(
            aspect, with_prism=True)),
    "random_scene": shirley.random_scene,
    "two_spheres": shirley.two_spheres,
    "two_perlin_spheres": shirley.two_perlin_spheres,
    "simple_light": shirley.simple_light,
    "final": shirley.final,
    "texture_mapped_sphere": misc.texture_mapped_sphere,
    "environment": misc.environment,
    "pbr_ibl": misc.pbr_ibl,
    "cornell_box_obj": misc.cornell_box_obj,
    "displacement_test": misc.displacement_test,
}
REGISTRY.update(extracted.CONSTRUCTORS)


def get_scene(name: str, aspect: float = 1.0):
    if name not in REGISTRY:
        raise KeyError(
            f"unknown scene {name!r}; available: {sorted(REGISTRY)}")
    return REGISTRY[name](aspect)
