from ensem3a_openclraytracer_tpu_torch.cli import main

if __name__ == "__main__":
    raise SystemExit(main())
