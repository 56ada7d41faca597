"""The plain reference: the models in float32 PyTorch read by the port's
state-dict keys, their operation counts, and nothing of the port."""
