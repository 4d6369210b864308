from rtwc_tpu_torch.engine.run import main

raise SystemExit(main())
