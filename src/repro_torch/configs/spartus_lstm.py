"""The paper's own acoustic-model configs (Table II) — DeltaLSTM + CBTD;
port of ``repro/configs/spartus_lstm.py``."""
from repro_torch.models.lstm_am import LSTMAMConfig

# Table II rows (TIMIT): the networks Spartus supports in hardware
LSTM_3L_512H = LSTMAMConfig(input_dim=123, hidden_dim=512, n_layers=3, n_classes=41)
LSTM_2L_768H = LSTMAMConfig(input_dim=123, hidden_dim=768, n_layers=2, n_classes=41)
LSTM_2L_1024H = LSTMAMConfig(input_dim=123, hidden_dim=1024, n_layers=2, n_classes=41)
# the hardware test network: top layer of the biggest AM (Sec. VI-C)
DELTA_LSTM_2L_1024H = LSTMAMConfig(
    input_dim=123, hidden_dim=1024, n_layers=2, n_classes=41,
    delta=True, theta=0.3,
)
