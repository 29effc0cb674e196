"""The benchmark of quadruped_tpu_torch on an NVIDIA H100: one command
runs one cell once (python3 port_bench/run.py --workload <name> ...)."""
