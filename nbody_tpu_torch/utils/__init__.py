"""Utilities: phase profiling, serialization, sharding-preserving
checkpoints.

The checkpoint functions load on first use: ``utils.checkpoint`` imports
``parallel``, whose kernels' modules import ``utils.profiling``.
"""

__all__ = ["restore_checkpoint", "save_checkpoint"]


def __getattr__(name):
    if name in __all__:
        from nbody_tpu_torch.utils import checkpoint

        return getattr(checkpoint, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
