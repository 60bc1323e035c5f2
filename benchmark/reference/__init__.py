"""The benchmark's plain references.  YOLOv2 and YOLOv3 live in ``nets.py``;
YOLOv4 in ``yolov4.py``, hooked into the dispatch on ``cfg["model"]`` here,
so that every import of a reference module sees it (``yolov4.register``)."""

from benchmark.reference import yolov4 as _yolov4

_yolov4.register()
