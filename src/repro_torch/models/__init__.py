"""Models of the port (``lstm_am``: the paper's LSTM acoustic model)."""
