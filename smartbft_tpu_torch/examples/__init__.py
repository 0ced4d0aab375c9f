"""Embedder examples: applications built on the library's public SPI
alone (``python -m smartbft_tpu_torch.examples.naive_chain``)."""
