"""The name patterns of the port's hand-written kernels
(``directx_raytracer_tpu_torch/csrc``), as torch.profiler names their
device records."""

OWN = {"closest_hit": ("closest_hit_kernel",),
       "any_hit": ("any_hit_kernel",),
       "bin_lists": ("bin_lists_kernel",),
       "precision_micro": ("fold_f32_kernel", "fold_mma_kernel")}


def is_own(name: str) -> bool:
    return any(p in name for pats in OWN.values() for p in pats)


def device_us(trace, group: str) -> float:
    """Device time (us) of the records of one hand-written kernel."""
    return sum(e - s for name, s, e in trace.kernels
               if any(p in name for p in OWN[group]))
