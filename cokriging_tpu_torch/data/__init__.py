from cokriging_tpu_torch.data.grids import (  # noqa: F401
    GridConfig,
    SpatialGrid,
    regrid,
    land_grid,
    monthly_avg,
    temporal_avg,
    apply_land_mask,
    prep_gridded_df,
    augment_dataset,
    augment_dataset_pred,
    set_main_coords,
    main_coords_array,
    produce_climatology_conus,
)
from cokriging_tpu_torch.data.readers import prep_sif, prep_xco2, prep_evi, read_transcom  # noqa: F401
