"""Detectors: YOLOv8 prediction and training, batched NMS, TAL, the datasets and the runner."""
