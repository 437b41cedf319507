"""int8 quantization of the DCL datapath (counterpart of ``repro.quant``):
``qtypes`` (grid, QTensor), ``calibrate`` (observers, scale tables) and
``qat`` (the fake-quant references of the int8 kernels, forward only)."""
