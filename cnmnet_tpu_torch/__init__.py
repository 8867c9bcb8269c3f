"""cnmnet_tpu_torch — the CNMNet pipeline in PyTorch for NVIDIA Hopper.

A second implementation of the ``cnmnet_tpu`` package, module for module
(each file here has one counterpart there, under the same path), held
against it by the tests in ``tests/test_torch_*.py``:

* plain tensor code is PyTorch (``nn.Module``s, functions on tensors, an
  explicit ``device``, explicit ``torch.Generator``s for initialisation);
* every op the JAX package runs as a Pallas TPU kernel is a CUDA C++
  kernel for ``sm_90a`` here (``kernels/csrc``), built with ``nvcc`` at
  first use and bound with ``ctypes``; its plain PyTorch version sits in
  ``ops/`` and serves CPU tensors;
* public inputs and outputs keep the JAX package's layouts (images
  ``[B, V, H, W, 3]``, cams ``[B, V, 2, 4, 4]``, NHWC outputs), while the
  convolutions run NCHW inside.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
