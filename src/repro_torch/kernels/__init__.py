"""Hand-written CUDA kernels of the port, each with its plain version.

  ntt/       negacyclic NTT, natural order at both ends, one launch
             (a thread-block cluster a row at logN > 14)
  bconv/     fast basis conversion, scale and reduce in one launch
  fused_ip/  keyswitch inner product with the fused plaintext multiply
  modup/     ModUp of every digit: INTT -> BConv reduce -> NTT, own
             limbs passed through, two launches

Sources are in ``repro_torch/csrc``; ``native`` builds and loads them.
A wrapper runs its plain version on CPU tensors and its kernel on CUDA
tensors.
"""
