"""Data-parallel training across processes: the process group, the mesh
and the sharding rules (the counterpart of ``climsim_tpu.parallel``)."""
