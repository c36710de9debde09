"""The port's counterparts of the JAX package's ``examples/`` scripts: the
reference-format training and evaluation scripts, and those that compare
engines against gymnasium's Box2D lander; each runs as ``python -m
deep_q_learning_tpu_torch.examples.<name> --device ...``."""
