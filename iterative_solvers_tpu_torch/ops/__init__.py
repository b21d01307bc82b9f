from . import stencils, curvilinear, dct, sparse  # noqa: F401
