from stf_unet_tpu_torch.pk.aif import (auto_detect_aif, make_aif,
                                      modified_aif, population_aif)
from stf_unet_tpu_torch.pk.enhanced import (compare_aif_methods,
                                           enhanced_preprocess,
                                           fit_volume_enhanced,
                                           postprocess_param_maps)
from stf_unet_tpu_torch.pk.fit import (fit_adam, fit_adam_debug, fit_lm,
                                      preprocess_images,
                                      tissue_mask_morphology)
from stf_unet_tpu_torch.pk.maps import (compare_aif_for_dataset, fit_volume,
                                       generate_pk_maps_for_dataset,
                                       process_dataset, process_patient)
from stf_unet_tpu_torch.pk.tofts import (ToftsQuadrature,
                                        extended_tofts_batch)

__all__ = [
    "population_aif",
    "modified_aif",
    "make_aif",
    "auto_detect_aif",
    "ToftsQuadrature",
    "extended_tofts_batch",
    "fit_adam",
    "fit_adam_debug",
    "fit_lm",
    "preprocess_images",
    "tissue_mask_morphology",
    "fit_volume",
    "process_patient",
    "process_dataset",
    "generate_pk_maps_for_dataset",
    "compare_aif_for_dataset",
    "enhanced_preprocess",
    "postprocess_param_maps",
    "fit_volume_enhanced",
    "compare_aif_methods",
]
