"""The benchmark's plain reference: a frozen copy of the port's plain chains
(``mpc_mmd_tpu_torch`` at commit eb91b04, the versions its CPU tests hold
to the JAX package), cut to what the cells run (``mmd_opt``, the
prefactored strategy, Gaussian noise, the laplace kernel, the inner CEM's
"xla" selection with elite-carry), with every hand-written kernel call
taken out and no CUDA graph, so that it runs plain PyTorch operations on
the card or the CPU.  A cell that runs another mode, noise or selection
copies its chain here.  It imports nothing of ``jax``, ``mpc_mmd_tpu`` or
``mpc_mmd_tpu_torch``, and works out everything the program's set-up
derives (basis, KKT factors, fixed draws, key chains) again itself.

Entry points: :class:`solver.Solver`, :class:`solver_frenet.FrenetSolver`,
:func:`closedloop.local_problem`, :func:`frenet.build_smoother`,
:func:`config.from_dict`.
"""
