"""Privacy subsystem — protections for the model updates themselves.

The federation keeps raw data on-device; this package closes the remaining
leak (updates are invertible) with three composable layers:

  dp.py          Client-side DP update privatization: the update delta is
                 clipped to global L2 norm ``dp_clip`` and perturbed with
                 Gaussian noise (std ``dp_noise_multiplier * dp_clip``)
                 before it leaves the client, through the
                 ``repro_torch.kernels.dp_clip_noise`` kernel on CUDA.

  secure_agg.py  Mask-based secure aggregation: pairwise seed-derived masks
                 added client-side cancel inside the server's single fused
                 N-way sum, with seed-reconstruction recovery when clients
                 drop mid-round (``PairwiseMasker``).

  accountant.py  RDP/moments accountant: composes every privatized release
                 into per-client and per-model (epsilon, delta) budgets,
                 surfaced via ``FedCCL.privacy_report()``
                 (``RDPAccountant``).

Wiring: ``FedCCLConfig(dp_clip=..., dp_noise_multiplier=..., secure_agg=True,
target_delta=...)`` — the facade attaches a ``DPPrivatizer`` to every
client, hands a ``PairwiseMasker`` to the ``ModelStore``, and the sim
runtime switches to full-round secure drains (``ModelStore.drain_secure``).
"""

from repro_torch.privacy.accountant import RDPAccountant, gaussian_rdp, rdp_to_epsilon
from repro_torch.privacy.dp import DPConfig, DPPrivatizer
from repro_torch.privacy.secure_agg import PairwiseMasker
