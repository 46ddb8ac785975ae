"""Detectors, prediction side: YOLOv8, batched NMS, the eval dataset and the runner."""
