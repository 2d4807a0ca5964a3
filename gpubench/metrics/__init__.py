"""Per-layer metric readers: metrics/<metric name>.py defines read(ctx)."""
