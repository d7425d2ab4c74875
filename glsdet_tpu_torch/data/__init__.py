"""The data constants the serving facades need and the device side of a
train batch (``device_color.py``); the datasets, loaders and
augmentations are still to be ported (ROADMAP.md, queue A item 11)."""
