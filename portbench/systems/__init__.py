"""Step builders of the configurations, one module per configuration's ``system``."""
