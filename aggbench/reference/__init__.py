"""The plain reference: what an exchange must deliver, in plain PyTorch.

It imports nothing of the port and takes nothing the port made: the
aggregator ranks come from :mod:`.roles`, the payload from
:mod:`aggbench.payload` and the seed, and the port's receive arena is
read only to be judged (:mod:`.exchange`).
"""
