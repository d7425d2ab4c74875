"""VisDrone constants, the port's copy of what the serving facades take
from ``glsdet_tpu.data.visdrone``.  The converter to COCO json is still
to be ported (ROADMAP.md, queue A item 11)."""

# COCO ``category_id = category - 1`` of VisDrone's annotation categories
# 1-10 (0, "ignored regions", and 11, "others", are dropped)
VISDRONE_CLASSES = (
    "pedestrian", "people", "bicycle", "car", "van", "truck",
    "tricycle", "awning-tricycle", "bus", "motor",
)
