"""The plain reference of the model, its training step and the comparisons
that decide ``correct``; it imports nothing of the port."""
