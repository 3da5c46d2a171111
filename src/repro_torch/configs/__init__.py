from .registry import ARCHS, SHAPES, get_config, input_specs, shape_applicable  # noqa: F401
