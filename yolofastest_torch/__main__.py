import sys

from yolofastest_torch.cli import main

sys.exit(main())
