"""Re-export of the optimizer core, as the JAX package's
``trainers/train_state.py`` re-exports its own."""

from ..optim import TrainState, clip_by_global_norm, make_optimizer

__all__ = ["TrainState", "clip_by_global_norm", "make_optimizer"]
