"""Training of the four heads (GF, RD, RM, ET): losses, batch functions, the trainer, validation and checkpoints."""
