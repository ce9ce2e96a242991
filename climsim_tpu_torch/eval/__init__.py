"""Offline and online scoring (the counterpart of ``climsim_tpu.eval``)."""
