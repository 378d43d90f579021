from .registry import (ARCHS, SHAPES, ShapeCell, applicable,  # noqa: F401
                       get_config, get_smoke_config, input_specs)
