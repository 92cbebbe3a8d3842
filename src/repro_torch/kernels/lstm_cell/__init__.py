from repro_torch.kernels.lstm_cell.ops import LSTMCellFn, lstm_cell_fused, lstm_step
