"""The committed orbax checkpoints, read with numpy: a frozen copy of the
port's reader (tfssd_torch/utils/{ocdbt,zstd,checkpoint}.py), so the
weights that both the program and the reference are given come from code
under the benchmark's own folder."""
