"""The port's measurement and run drivers, the counterparts of the JAX
repo's scripts/ (readgen.py, scale_run.py, gen_scale_input.py,
longread_run.py, scale_exp.py, scale_shards.py) under the same names.
Each runs as ``python -m ropebwt2_tpu_torch.scripts.<name>``, on the card
unless the caller asks for the CPU, and writes its record only under
smoke_out/ unless told another path.
"""
