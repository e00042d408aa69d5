"""Eval-side tensor ops: tiled forward, illuminance correction, metrics
(counterpart of ``eld_tpu.ops``)."""
