"""Show-o v1 training: corruption, LR schedules, the fused step, the trainer."""
