"""Loss constants (the counterpart of trackmpnn_tpu/losses/losses.py).

The block train step (train/block.py) computes its losses in block layout
itself; all it takes from here is the log floor."""

EPS = 1e-10  # added inside log(p) of the BCE terms (losses.py:32 of the JAX package)
