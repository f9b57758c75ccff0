"""Faults of the cells whose traffic drives ``dense_engine``
(``DenseEngine.build``): a step that returns its state, half of the MRs
left out, an answer altered where it is produced, an MR too many."""
from rlcbench.tests.program_faults import (an_mr_too_many,
                                           closure_returns_its_state,
                                           half_the_mrs,
                                           one_reach_bit_flipped)

FAULTS = [closure_returns_its_state, half_the_mrs, one_reach_bit_flipped,
          an_mr_too_many]
