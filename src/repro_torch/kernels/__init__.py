"""Aggregation kernels: plain versions (``ref``), CUDA sources (``csrc``),
their build (``build``) and the device dispatch (``ops``)."""
