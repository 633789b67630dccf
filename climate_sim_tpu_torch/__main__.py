from .runtime.cli import main

raise SystemExit(main())
