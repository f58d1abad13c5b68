"""The plain reference of LatentSync 1.5 stage 2: float32 PyTorch, no kernel of the port."""
