"""The plain reference: f32 PyTorch that imports nothing of the program."""
