"""CG-Aug's reference generation path: label-space editing, ControlNet-SD1.5
sampling, SAM's box-prompted IoU gate and the Mask2Anomaly score gate
(counterpart of ``multishiftseg_tpu/cgaug``; the compact trainable backends
are not ported yet)."""
