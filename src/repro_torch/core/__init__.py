"""FASE core (PyTorch port): CPU interface, HTP protocol, host runtime."""
