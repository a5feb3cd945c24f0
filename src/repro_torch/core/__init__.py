"""Core: the paper's contributions as PyTorch functions (port of
``repro/core``).

- DeltaLSTM (temporal sparsity, Sec. II)
- CBTD structured pruning (spatial sparsity, Sec. III-A/B)
- CBCSC sparse format (Sec. III-C)
- fixed-point quantization (Sec. IV-E)
"""
from repro_torch.core.cbcsc import CBCSC, blen_for, cbcsc_decode, cbcsc_encode
from repro_torch.core.cbtd import apply_cbtd, cbtd_mask, drop_count, keep_count
from repro_torch.core.delta_lstm import (
    DeltaLSTMState,
    delta_lstm_layer,
    delta_lstm_step,
    delta_threshold,
    init_delta_lstm_state,
    init_lstm_params,
    lstm_layer,
    lstm_step,
    stacked_weight_matrix,
)
from repro_torch.core.quantization import (
    QuantConfig,
    fake_quant_act_ste,
    fake_quant_ste,
    int8_pack,
    pow2_scale_for,
    quantize,
    quantize_act,
)
