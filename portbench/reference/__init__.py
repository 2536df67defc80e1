"""The plain reference: PyTorch and numpy in float32 with TF32 off. It
imports nothing of the program under test."""
