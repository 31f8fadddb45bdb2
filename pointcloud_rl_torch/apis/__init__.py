"""Training entry points (``run_rl`` CLI, ``train_rl`` loop)."""
