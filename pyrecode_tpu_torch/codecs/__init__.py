"""Entropy coding of the port on torch tensors: :mod:`.dyndeflate`."""
