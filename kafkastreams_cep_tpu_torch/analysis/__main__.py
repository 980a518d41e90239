"""`python -m kafkastreams_cep_tpu_torch.analysis`: the port's gate."""
import sys

from .cli import main

sys.exit(main())
