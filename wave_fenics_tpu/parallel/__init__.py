from . import (  # noqa: F401
    distributed,
    halo,
    partition,
    sharded_general,
    sharded_wave,
)
