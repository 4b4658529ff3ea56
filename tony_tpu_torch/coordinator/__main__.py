from tony_tpu_torch.coordinator.coordinator import main

if __name__ == "__main__":
    raise SystemExit(main())
