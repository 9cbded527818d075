from .pyramid import Pyramid, PyramidSpec, build_pyramid

__all__ = ["Pyramid", "PyramidSpec", "build_pyramid"]
