"""Data layer of the port: frames read without OpenCV (``image_io``),
the COCO reader and VisDrone converter, the YOLOX-recipe augmentations,
the dataset wrappers, the training loader on worker processes, and the
device-side colour and geometric stages of a train batch."""
