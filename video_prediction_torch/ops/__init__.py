"""Layer primitives, the ConvLSTM cell and CDNA kernel application."""
