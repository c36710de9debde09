from deep_q_learning_tpu_torch.parallel.population import (
    PopulationTrainer,
    build_population,
    candidate_overrides,
    set_population_hyper,
    train_population,
)
