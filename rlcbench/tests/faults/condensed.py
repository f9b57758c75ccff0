"""Faults of the cells whose traffic drives ``condensed``
(``build_condensed_device`` over a reach made in set-up): a closure step
and a hub batch that return their state, half of each hub batch left
out, an entry altered where it is produced."""
from rlcbench.tests.program_faults import (closure_returns_its_state,
                                           half_of_each_hub_batch,
                                           hub_step_returns_its_state,
                                           one_entry_altered)

FAULTS = [closure_returns_its_state, hub_step_returns_its_state,
          half_of_each_hub_batch, one_entry_altered]
