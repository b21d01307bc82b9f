from . import swift_hohenberg, mems, droplet, heat, wave, poisson  # noqa: F401
