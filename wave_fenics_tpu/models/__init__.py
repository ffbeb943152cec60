from . import diagnostics, general_wave, linear_wave, planar3d  # noqa: F401
