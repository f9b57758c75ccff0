"""Faults of the cells whose traffic drives ``condensed_on_card``
(``build_condensed_device`` over a reach that ``device_reach`` made and
left on the card): a closure step and a hub batch that return their
state, half of each hub batch left out, an entry altered where it is
produced, and one defined here, a bit of ``device_reach``'s reach
flipped."""
from rlcbench.tests.program_faults import (closure_returns_its_state,
                                           half_of_each_hub_batch,
                                           hub_step_returns_its_state,
                                           one_entry_altered)


def one_device_reach_bit_flipped(monkeypatch):
    """The reach ``device_reach`` hands back with one cell altered."""
    from repro_torch.core import dense
    real = dense.device_reach

    def device_reach(*args, **kwargs):
        mrs, R = real(*args, **kwargs)
        R[0, 0, 1] = ~R[0, 0, 1]
        return mrs, R
    monkeypatch.setattr(dense, "device_reach", device_reach)


FAULTS = [closure_returns_its_state, hub_step_returns_its_state,
          half_of_each_hub_batch, one_entry_altered,
          one_device_reach_bit_flipped]
