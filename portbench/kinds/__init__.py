"""Program drivers, one module per configuration kind."""
