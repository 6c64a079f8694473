"""The kernel wrappers' launch counters, read and reset together.

Each wrapper in index/cuda_adc.py and index/cuda_ivf.py adds one to its own
counter where it launches its kernel; a CPU tensor takes the plain version
and counts nothing. `counts()` reads them all, with the two searches'
rerun counters; `reset()` sets them all to 0.
"""
from __future__ import annotations


def counts() -> dict:
    from repconc_tpu_torch.index.cuda_adc import (adc_filter, adc_group_max,
                                                  adc_scores, adc_scores_int8,
                                                  adc_topk)
    from repconc_tpu_torch.index.cuda_ivf import (ivf_filter, ivf_group_max,
                                                  ivf_topk, score_work_tiles)

    return {"adc_scan": adc_scores.launches,
            "adc_group_max": adc_group_max.launches,
            "adc_filter": adc_filter.launches,
            "adc_topk_reruns": adc_topk.reruns,
            "ivf_scan_bf16": score_work_tiles.launches["bf16"],
            "ivf_scan_i8": score_work_tiles.launches["int8"],
            "ivf_group_max_bf16": ivf_group_max.launches["bf16"],
            "ivf_group_max_i8": ivf_group_max.launches["int8"],
            "ivf_filter_bf16": ivf_filter.launches["bf16"],
            "ivf_filter_i8": ivf_filter.launches["int8"],
            "ivf_topk_reruns": ivf_topk.reruns,
            "adc_scan_i8": adc_scores_int8.launches}


def reset() -> None:
    from repconc_tpu_torch.index.cuda_adc import (adc_filter, adc_group_max,
                                                  adc_scores, adc_scores_int8,
                                                  adc_topk)
    from repconc_tpu_torch.index.cuda_ivf import (ivf_filter, ivf_group_max,
                                                  ivf_topk, score_work_tiles)

    adc_scores.launches = 0
    adc_group_max.launches = 0
    adc_filter.launches = 0
    adc_topk.reruns = 0
    adc_scores_int8.launches = 0
    score_work_tiles.launches = {"bf16": 0, "int8": 0}
    ivf_group_max.launches = {"bf16": 0, "int8": 0}
    ivf_filter.launches = {"bf16": 0, "int8": 0}
    ivf_topk.reruns = 0
