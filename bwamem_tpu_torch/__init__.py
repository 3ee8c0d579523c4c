"""PyTorch/CUDA port of bwamem_tpu: `mem` on an NVIDIA H100, and every
other bwa command on the host (cli.py), with the entry points
graft_entry, bench and run_eval."""
