"""Core: the paper's contributions as PyTorch functions (port of
``repro/core``).

- DeltaLSTM / DeltaGRU / DeltaLinear (temporal sparsity, Sec. II)
- CBTD structured pruning (spatial sparsity, Sec. III-A/B)
- CBCSC sparse format (Sec. III-C)
- fixed-point quantization (Sec. IV-E)
- sparsity statistics / op accounting (eqs. 9-10, Tables II/IV)
"""
from repro_torch.core.cbcsc import CBCSC, blen_for, cbcsc_decode, cbcsc_encode
from repro_torch.core.cbtd import (
    CBTDConfig,
    alpha_at,
    apply_cbtd,
    cbtd_mask,
    cbtd_prune_tree,
    cbtd_tile_mask,
    drop_count,
    keep_count,
)
from repro_torch.core.delta_gru import (
    DeltaGRUState,
    delta_gru_layer,
    delta_gru_step,
    gru_layer,
    gru_step,
    init_delta_gru_state,
    init_gru_params,
)
from repro_torch.core.delta_linear import (
    DeltaLinearState,
    delta_linear_over_time,
    delta_linear_step,
    init_delta_linear_state,
)
from repro_torch.core.delta_lstm import (
    DeltaLSTMState,
    delta_lstm_layer,
    delta_lstm_layer_batched,
    delta_lstm_step,
    delta_threshold,
    init_delta_lstm_state,
    init_lstm_params,
    lstm_layer,
    lstm_layer_batched,
    lstm_step,
    stacked_weight_matrix,
)
from repro_torch.core.quantization import (
    QuantConfig,
    fake_quant_act_ste,
    fake_quant_ste,
    int8_pack,
    int8_unpack,
    pow2_scale_for,
    quantize,
    quantize_act,
    quantize_tree,
)
from repro_torch.core.stats import (
    balance_ratio,
    effective_mac_trace,
    lstm_layer_macs,
    lstm_layer_ops,
    model_size_mb,
    op_saving,
    sparse_model_size_mb,
    summarize_delta_aux,
    temporal_sparsity,
    tree_weight_sparsity,
    weight_sparsity,
)
