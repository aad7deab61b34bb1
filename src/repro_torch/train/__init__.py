# Training on one card: the optimizers (AdamW, Adafactor), the train
# step with accumulation and compression, checkpoints in the JAX
# package's format, and the fault-tolerant supervisor.
from . import checkpoint, fault, optimizer, train_state  # noqa: F401
