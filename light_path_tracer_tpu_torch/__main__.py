from light_path_tracer_tpu_torch.cli import main

raise SystemExit(main())
