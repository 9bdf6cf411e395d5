"""End-to-end workloads (port of isopoints_tpu/workloads)."""
