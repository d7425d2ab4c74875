"""The data constants the serving facades need; the datasets, loaders
and augmentations are still to be ported (ROADMAP.md, queue A item 11)."""
