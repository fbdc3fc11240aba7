"""Training: losses, mixup/cutmix, EMA, schedules, the train step, the
CLI."""
