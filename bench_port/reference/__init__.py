"""The plain PyTorch reference of the trainer entries the cells drive."""
