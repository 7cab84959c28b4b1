from .functional_map import (
    p2p_matrix,
    functional_map_from_p2p,
    map_eigenfunctions_p2p,
    check_source_basis_matches_trained,
    get_remapped_efuncs_with_fm_gt,
)
