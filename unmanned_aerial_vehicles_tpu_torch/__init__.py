"""PyTorch/CUDA port of the quadrotor GP-MPC framework.

A second package beside ``unmanned_aerial_vehicles_tpu`` (the JAX reference,
which stays as it is). Module names and public function names follow the JAX
package, so each counterpart is easy to find: ``loop.closed_loop`` here is
``loop.closed_loop`` there.

Plain tensor code is PyTorch. Every kernel that the JAX package wrote in
Pallas for the TPU becomes a kernel written by hand for Hopper (CUDA C++ in
``csrc/``, built for ``sm_90a`` at first use). Beside each kernel sits its
plain PyTorch version: a wrapper runs the plain version only for tensors on
the CPU; for CUDA tensors it launches the kernel or raises.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; with
no GPU they raise rather than carry on quietly on the CPU.

Sub-packages
------------
``models``        double integrator, PX4 rate-loop surrogate, 12-state rigid
                  body, parameters
``trajectories``  the ramped figure-8 and circle references
``control``       geometric allocation, condensed linear MPC, the 12-state
                  SQP family (torque, direct-rate, LTV tracking), MPPI
``gp``            exact GP, the residual-dynamics ring buffer, per-dimension
                  GPs, evaluation and model analysis
``estimation``    EKF, disturbance observer, noisy-sensor flights
``ops``           box-QP ADMM, LTV condensation and the hand-written kernels
                  (plants, ticks, batched controller, GP posterior mean,
                  noisy tick, rigid plant, rigid multi-tick, MPPI sampling,
                  the plant VJPs)
``loop``          closed-loop flights, the batched throughput sweep and the
                  12-state multi-tick tiers
``parallel``      the full-corpus GP (row-sharded CG through the Gram
                  kernel) and flight and hyperparameter sweeps, over a
                  ``torch.distributed`` mesh or on one card
``io``            datasets (a native CSV parser), flight logs (npz and the
                  native ``uavlog`` recorder), GP and resume checkpoints,
                  the reference's sklearn pickles, synthetic data
``metrics``       tracking and performance metrics, plots, animated replays
``utils``         rotations, device timers and traces
``tuning``        gradient descent on the cascade-PID gains and the MPC
                  weights through whole flights (the kernels' VJPs)
``convert``       carries the JAX package's values (as numpy) across
"""

__version__ = "0.1.0"
