"""portbench: the benchmark of the PyTorch and CUDA ClimSim port
(``climsim_tpu_torch``), driven by data files.  See README.md."""
