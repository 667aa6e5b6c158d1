"""The plain reference of the port's scoring and training paths: plain
PyTorch in float32 (TF32 off where it runs), importing nothing of the port
and taking nothing the port made."""
