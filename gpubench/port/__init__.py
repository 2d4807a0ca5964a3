"""The program under test, by family: ``port/<family>.py`` defines
``model_config(config)``, the ``repro_torch.models.ModelConfig`` that a
configuration file of that family states, and refuses a file the port
would run otherwise than the source (a capacity that drops tokens). The
harness's modules that import the program are these, the drivers and
``metrics/_spans.py``."""
