"""Weight conversion, checkpoints and preemption."""
