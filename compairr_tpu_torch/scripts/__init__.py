"""The port's scripts, each run as
`python -m compairr_tpu_torch.scripts.<name>`: weak_scaling (the dense
engine over 1, 2, 4, ... shards), scale_demo (the Keck-scale generator
and a CLI run), multihost_demo (per-host input shards merged into one
run's matrix) and ab_compare with its probes ab_probe_dense and
ab_probe_count (two trees timed in turns)."""
