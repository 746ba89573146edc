"""Hand-written CUDA kernels of the port, each with its plain version.

  ntt/       negacyclic NTT (two launches at logN > 11)
  bconv/     fast basis conversion, scale and reduce in one launch
  fused_ip/  keyswitch inner product with the fused plaintext multiply
  modup/     one digit's ModUp: INTT -> BConv reduce -> NTT

Sources are in ``repro_torch/csrc``; ``native`` builds and loads them.
A wrapper runs its plain version on CPU tensors and its kernel on CUDA
tensors.
"""
