"""Compute kernels (layer T2) of the signal chain.

fft, fir (through conv_backend) and sync are plain jax.numpy/lax
formulations that XLA compiles for the device (cuFFT and fused
elementwise/matmul kernels on a GPU); they are tested against the
float64 golden NumPy chain (tests/kernels/).

viterbi is the one hand-written kernel: a fused Pallas decoder on the
Triton route, selected by `WaveformSpec.kernel_backend='auto'` on a CUDA
device, with the XLA decoders of phy.bits as its reference.
"""

from . import fft, fir, sync  # noqa: F401
