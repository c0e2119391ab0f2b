"""hevc_tpu — an HEVC/SHVC decode engine on a GPU.

A ground-up reimplementation of the capabilities of openHEVC (wei1ji/HEVC):
the bitstream/entropy front-end runs on the host (stage A, native C++),
emitting dense per-CTU symbol tensors; reconstruction (stage B:
dequant/IDCT, intra prediction, motion compensation, deblocking, SAO,
inter-layer upsampling) runs as JAX/XLA programs on the device, optionally
sharded over a device mesh for tile/frame parallelism.

Reference capability map: see SURVEY.md at the repo root.
"""

__version__ = "0.1.0"
