import sys

from llama_cu_awq_torch.cli import main

sys.exit(main())
