from mlcomp_tpu_torch.contrib.split.frame import (
    group_k_fold, stratified_group_k_fold, stratified_k_fold,
)

__all__ = ['stratified_k_fold', 'stratified_group_k_fold', 'group_k_fold']
