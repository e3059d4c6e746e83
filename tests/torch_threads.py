"""One torch thread a test process: importing this module sets torch's
intra-op threads to one.

The tests run in several worker processes on a box's few cores, beside
JAX's own thread pools, and torch's pool meets at a barrier in every op it
splits: where its threads outnumber the free cores, each of a plain
lattice's thousands of small ops waits on a descheduled thread
(``ops/lattice.py``'s U = 601 took 52 s on eight threads beside eight busy
processes, 0.32 s on one). The port's CPU tests run the plain versions at
small sizes, where one thread is as fast as eight on an idle box. A module
opts in with

    import torch_threads  # noqa: F401  (one torch thread a process)

and every module that imports ``jax_programs`` is in already.
"""
import torch

torch.set_num_threads(1)
