"""The benchmark of repro_torch: harness, plain reference, configurations,
traffic mixes, per-layer metric readers and their tests."""
