"""Distribution: the pair axis of evaluation (``eval``), multi-process
helpers (``multihost``), data-parallel training (``mesh``) and the
collectives they share (``collectives``), on ``torch.distributed``."""
