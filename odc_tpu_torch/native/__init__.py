"""The port's C++ host library: JPEG decode and cv2-convention bilinear
resize (``native/src/loader.cc``), bound with ctypes in
:mod:`odc_tpu_torch.native.loader` and built with g++ at first use."""
