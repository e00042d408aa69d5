"""Training: state, steps and the Engine (counterpart of ``eld_tpu.train``)."""
