"""Tools layer of the port: calibration, backscattering, offline converters,
validation frames and the live viewer (pyrecode_tpu/utils/ on PyTorch).
"""
