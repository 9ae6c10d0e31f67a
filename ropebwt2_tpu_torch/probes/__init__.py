"""The probe suite for the card: the counterparts of the JAX package's
TPU probe scripts, each asking the CUDA kernels what its script asked of
the Pallas kernels.

- ``kernel_scaling`` (H, scripts/probe_kernel_scaling.py): kernel A
  chained, cost per CTA and per super-block against its bound;
- ``merge_phases`` (F, scripts/probe_merge_tpu.py): kernel A's wrapper
  split into its steps, each timed;
- ``kernel_stages`` (E, scripts/probe_kernel_stages.py): kernel A's stages
  looped alone (csrc/probes/stages.cu);
- ``warmup_build`` (D, scripts/probe_warmup_aot.py): a cold build, and a
  fresh process's way to a first kernel result (csrc/probes/toy.cu);
- ``kernel_features`` (G, scripts/probe_kfeat_tpu.py): the Hopper features
  a redesign of A, B or C would use (csrc/probes/features.cu).

Each runs as ``python -m ropebwt2_tpu_torch.probes.<name>`` and refuses to
run without a card; ``chip_smoke.py`` phase 7 runs them all.  Their
plain versions run on CPU tensors, which is what the CPU tests use.
"""
